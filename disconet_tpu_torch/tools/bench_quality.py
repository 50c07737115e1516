"""Detection- and tracking-quality protocol of the port, the counterpart of
the JAX package's ``tools/bench_quality.py``.

    python -m disconet_tpu_torch.tools.bench_quality --root build/quality \
        --occlusion 1 --configs disco lowerbound --seeds 0 --track_evals \
        --out results/port_occluded_matrix.json
    python -m disconet_tpu_torch.tools.bench_quality --out results/port_occluded_matrix.json --summarize

Each (config, seed) cell trains through the port's ``train_codet`` (``--nepoch``
epochs at ``--batch``, ``--steps_per_dispatch`` steps a dispatch, 8 by
default as the JAX matrix trained, the final epoch's checkpoint only:
``--ckpt_every nepoch --ckpt_keep 1``; ``--max_pos`` passes through) and
evaluates that checkpoint on the val split through ``test_codet``.
``--save_best 1`` trains with ``train_codet --save_best 1`` and measures the
checkpoint of the lowest end-of-epoch loss (``best.pth``), and the final
one beside it (the cell's ``final`` entry); the default, 0, is the final
checkpoint, as the committed port and JAX ``disco``/``lowerbound`` cells
were measured. Every cell stamps ``"ckpt": "best"|"final"``.
``--track_evals`` adds, for the trained configs of ``TRACK_EVALS``,
``test_codet --tracking --split val`` -> ``sort`` -> ``eval_mot`` in the
config's own tracking log path. ``--extra_evals`` adds the eval-only rows of
``EXTRA_EVALS`` (pose noise, late fusion) over the trained checkpoints of
their base configs, training a base whose checkpoint is gone (that training
writes no cell). The data are the JAX protocol's: ``create_data_det
--occlusion 1`` at ``--grid 64``, 24 train and 24 val scenes of 8 frames, the
files the JAX generator writes.

Results accumulate in ``--out`` under the JAX matrix's keys
(``disco/seed0``, ``disco+track/seed0``, ``disco+noise/seed0``); a key
already there is skipped, so the cells can run over several calls, and
processes that share an ``--out`` (say, one per group of seeds on one card)
add their cells under a file lock. Every cell stamps the card
(``nvidia-smi`` name and power limit), the commit, a digest of the port's
sources and its wall seconds. ``--summarize`` prints the port's cells beside
the JAX matrix's (``results/occluded_matrix.json``), then the JAX harness's
``ORDERINGS`` (mAP) and ``TRACK_ORDERINGS`` (MOTA) between the port's
configs whose cells exist, with ``ordering_stats``, Welch's test and each
side's seeds.

The CLIs run as ``python -m`` processes, or in this process with
``--inprocess`` (the tests). ``--device`` passes through; the card by default.
"""

from __future__ import annotations

import argparse
import contextlib
import fcntl
import hashlib
import importlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JAX_MATRIX = os.path.join(REPO, "results", "occluded_matrix.json")

# config -> train/test flags, as the JAX protocol's; the intermediate-fusion
# cells pin the fusion layer
CONFIGS = {
    "lowerbound": ["--bound", "lowerbound"],
    "upperbound": ["--bound", "upperbound"],
    "when2com": ["--com", "when2com", "--layer", "3"],
    "v2v": ["--com", "v2v", "--layer", "3"],
    "disco": ["--com", "disco", "--layer", "3"],
    "disco_kd": ["--com", "disco", "--kd_flag", "1", "--layer", "3"],
    "disco_norsu": ["--com", "disco", "--rsu", "0", "--layer", "3"],
    "mean": ["--com", "mean", "--layer", "3"],
    "max": ["--com", "max", "--layer", "3"],
    "disco_l2": ["--com", "disco", "--layer", "2"],
    "disco_kd_l2": ["--com", "disco", "--kd_flag", "1", "--layer", "2"],
    "v2v_l2": ["--com", "v2v", "--layer", "2"],
    "when2com_l2": ["--com", "when2com", "--layer", "2"],
    "who2com_l2": ["--com", "who2com", "--layer", "2"],
    "disco_l2_norsu": ["--com", "disco", "--rsu", "0", "--layer", "2"],
    # disco_l2 trained again in a directory of its own (the JAX matrix's
    # trajectory check of its packed loss)
    "disco_l2_hv": ["--com", "disco", "--layer", "2"],
    # V2VNet with one ConvGRU round instead of three
    "v2v_l2_r1": ["--com", "v2v", "--layer", "2", "--gru_rounds", "1"],
}
# configs whose train log directory ({com}[_kd]) another config shares: they
# train under a log path of their own
MODE_DIR = {
    "disco_norsu": "disco",
    "disco_l2": "disco",
    "disco_kd_l2": "disco_kd",
    "v2v_l2": "v2v",
    "when2com_l2": "when2com",
    "who2com_l2": "who2com",
    "disco_l2_norsu": "disco",
    "disco_l2_hv": "disco",
    "v2v_l2_r1": "v2v",
}
TRACK_EVALS = ("disco_kd", "disco", "lowerbound")

# eval-only rows: (base config, extra test_codet flags) over the base's
# trained checkpoint, the JAX harness's: pose noise of 0.4 m and 4 degrees
# (--pose_noise_rot_std is in radians), and late fusion
_ROT_4DEG = f"{4 * math.pi / 180:.6f}"
EXTRA_EVALS = {
    "disco_kd+noise": ("disco_kd", ["--pose_noise_std", "0.4", "--pose_noise_rot_std", _ROT_4DEG]),
    "disco+noise": ("disco", ["--pose_noise_std", "0.4", "--pose_noise_rot_std", _ROT_4DEG]),
    "disco_kd+latefuse": ("disco_kd", ["--apply_late_fusion", "1"]),
}

# (hi, lo) ordering claims of the JAX harness, checked by --summarize on mAP
ORDERINGS = [
    ("upperbound", "lowerbound"), ("disco_kd", "disco"),
    ("disco", "lowerbound"), ("disco_kd", "lowerbound"),
    ("v2v", "when2com"), ("when2com", "lowerbound"),
    ("disco", "disco_norsu"),
    ("disco_l2", "disco"), ("disco_l2", "lowerbound"),
    ("disco_kd_l2", "disco_kd"), ("disco_kd_l2", "disco_l2"),
    ("disco_kd_l2", "lowerbound"), ("v2v_l2", "v2v"),
    ("v2v_l2", "lowerbound"), ("disco_l2", "v2v_l2"),
    ("v2v_l2", "when2com_l2"), ("when2com_l2", "lowerbound"),
    ("disco_l2", "when2com_l2"),
    ("disco_norsu", "lowerbound"),
    ("disco_l2", "disco_l2_norsu"), ("disco_l2_norsu", "lowerbound"),
    ("disco_l2_hv", "lowerbound"), ("disco_l2_hv", "disco_l2"),
    ("who2com_l2", "lowerbound"), ("when2com_l2", "who2com_l2"),
    ("disco_l2", "who2com_l2"),
    ("v2v_l2_r1", "lowerbound"), ("v2v_l2", "v2v_l2_r1"),
    ("disco_l2", "v2v_l2_r1"),
    ("disco_kd+noise", "lowerbound"), ("disco_kd", "disco_kd+noise"),
    ("disco+noise", "lowerbound"), ("disco_kd+latefuse", "disco_kd"),
]
# the same on MOTA over the --track_evals rows
TRACK_ORDERINGS = [
    ("disco_kd+track", "lowerbound+track"),
    ("disco_kd+track", "disco+track"),
    ("disco+track", "lowerbound+track"),
]

AVG_RE = re.compile(r"average \|\s+([\d.]+) \|\s+([\d.]+) \|\s+(\d+) \|\s+(\d+)")
MOT_AVG_RE = re.compile(r"avg \|\s+(-?[\d.]+) \|\s+([\d.]+)")
EPOCH_LOSS_RE = re.compile(r"epoch \d+ done .*?(?<![\w])loss=(-?nan|-?inf|[\d.eE+-]+)")
# train_codet --save_best's record line (the last one names best.pth's epoch)
BEST_CKPT_RE = re.compile(r"best checkpoint: epoch (\d+) loss=(-?nan|-?inf|[\d.eE+-]+)")
# a non-finite epoch loss in the JSON: large enough to flag the cell
NONFINITE_LOSS = 1e30


def card() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` gives it."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def git_commit() -> str:
    try:
        sha = subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True,
                             cwd=REPO, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        sha = ""
    return sha or "unknown"


def source_digest() -> str:
    """sha1 over the port's Python and CUDA sources, in path order: names
    the code that ran a cell where no git checkout is at hand."""
    h = hashlib.sha1()
    pkg = os.path.join(REPO, "disconet_tpu_torch")
    for d, _, files in sorted(os.walk(pkg)):
        for f in sorted(files):
            if f.endswith((".py", ".cu")):
                path = os.path.join(d, f)
                h.update(os.path.relpath(path, REPO).encode())
                with open(path, "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()[:12]


def run_cli(module: str, argv, log_file: str, inprocess: bool) -> str:
    """Run ``disconet_tpu_torch.tools.<module>`` with ``argv``, appending the
    command line and its output to ``log_file``; returns the output. A
    failing run raises RuntimeError."""
    name = f"disconet_tpu_torch.tools.{module}"
    with open(log_file, "a") as f:
        f.write(f"\n$ python -m {name} {' '.join(argv)}\n")
    if inprocess:
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                importlib.import_module(name).main(list(argv))
            ok = True
        except SystemExit as e:
            ok = e.code in (None, 0)
            buf.write(f"SystemExit: {e.code}\n")
        out = buf.getvalue()
    else:
        r = subprocess.run([sys.executable, "-m", name, *argv], capture_output=True, text=True, cwd=REPO)
        out, ok = r.stdout + r.stderr, r.returncode == 0
    with open(log_file, "a") as f:
        f.write(out)
    if not ok:
        raise RuntimeError(f"{name} failed (see {log_file})")
    return out


def epoch_loss_stats(log_file: str) -> dict:
    """{final_epoch_loss, min_epoch_loss} of the last train run in the log."""
    losses = []
    for m in EPOCH_LOSS_RE.finditer(_last_train_run(log_file)):
        v = float(m.group(1))
        losses.append(v if math.isfinite(v) else NONFINITE_LOSS)
    return {"final_epoch_loss": losses[-1], "min_epoch_loss": min(losses)} if losses else {}


def _last_train_run(log_file: str) -> str:
    """The log from the last ``train_codet`` command on."""
    with open(log_file) as f:
        text = f.read()
    starts = [m.end() for m in re.finditer(r"^\$ .*train_codet.*$", text, re.M)]
    return text[starts[-1]:] if starts else text


def best_ckpt_stats(log_file: str) -> dict:
    """{best_epoch, best_epoch_loss} of the last train run's ``--save_best``
    record, or {}."""
    hits = BEST_CKPT_RE.findall(_last_train_run(log_file))
    if not hits:
        return {}
    epoch, loss = hits[-1]
    loss = float(loss)
    return {"best_epoch": int(epoch), "best_epoch_loss": loss if math.isfinite(loss) else NONFINITE_LOSS}


def load_results(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(results: dict, path: str) -> None:
    """Write ``results`` atomically, so that a run cut mid-write leaves the
    previous file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    os.replace(path + ".tmp", path)


def record(path: str, key: str, value: dict, results: dict) -> None:
    """Add the cell ``key`` to ``results`` and to the file ``path``, under
    an exclusive lock on ``path.lock``: the file is read again, so the cells
    other processes added since stay."""
    results[key] = value
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            cells = load_results(path)
            cells[key] = value
            save_results(cells, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def stamp(args, flags, seconds: dict, ckpt: str = "final") -> dict:
    layer = int(flags[flags.index("--layer") + 1]) if "--layer" in flags else None
    # "sha", "grid", "nepoch": the stamp of every results/ matrix cell
    return {"card": args.card, "sha": args.commit, "source_sha1": args.source_sha1,
            "device": args.device, "grid": args.grid, "nepoch": args.nepoch, "batch": args.batch,
            "steps_per_dispatch": args.steps_per_dispatch, "layer": layer, "ckpt": ckpt,
            **{k: round(v, 1) for k, v in seconds.items()}}


def cell_dirs(args, name: str, seed: int):
    """(log path of the cell, its train log directory)."""
    logpath = os.path.join(args.root, "logs", f"seed{seed}")
    if name in MODE_DIR:
        logpath = os.path.join(logpath, name)
    return logpath, os.path.join(logpath, MODE_DIR.get(name, name))


def final_ckpt(args, name: str, seed: int) -> str:
    return os.path.join(cell_dirs(args, name, seed)[1], f"epoch_{args.nepoch}.pth")


def best_ckpt(args, name: str, seed: int) -> str:
    return os.path.join(cell_dirs(args, name, seed)[1], "best.pth")


def measured_ckpt(args, name: str, seed: int, results: dict) -> str:
    """The checkpoint a row derived from the trained cell ``name`` reads:
    the one the cell was measured on (its ``ckpt`` stamp), else the one
    ``--save_best`` picks."""
    cell = results.get(f"{name}/seed{seed}")
    kind = cell["prov"]["ckpt"] if cell else ("best" if args.save_best else "final")
    return best_ckpt(args, name, seed) if kind == "best" else final_ckpt(args, name, seed)


def train(args, name: str, seed: int, log_file: str) -> bool:
    """Train the cell ``name`` at ``seed`` where its checkpoints are gone (a
    KD cell's teacher, its seed's final ``upperbound``, first); whether it
    trained."""
    need = [final_ckpt(args, name, seed)] + ([best_ckpt(args, name, seed)] if args.save_best else [])
    if all(os.path.exists(p) for p in need):
        return False
    flags = list(CONFIGS[name])
    if "--kd_flag" in flags:  # the same seed's trained upperbound teaches
        teacher = final_ckpt(args, "upperbound", seed)
        if not os.path.exists(teacher):
            up_logpath = cell_dirs(args, "upperbound", seed)[0]
            os.makedirs(up_logpath, exist_ok=True)
            train(args, "upperbound", seed, os.path.join(up_logpath, "upperbound.log"))
        flags += ["--resume_teacher", teacher]
    run_cli("det.train_codet", ["--data", os.path.join(args.root, "train"), *flags,
                                "--batch", str(args.batch), "--nepoch", str(args.nepoch),
                                "--grid", str(args.grid), "--seed", str(seed),
                                "--logpath", cell_dirs(args, name, seed)[0],
                                "--ckpt_every", str(args.nepoch), "--ckpt_keep", "1",
                                "--steps_per_dispatch", str(args.steps_per_dispatch),
                                "--save_best", str(args.save_best), "--max_pos", str(args.max_pos),
                                "--device", args.device], log_file, args.inprocess)
    return True


def test_flags(name: str):
    """The config's flags for ``test_codet``: ``--kd_flag`` and its value go."""
    flags = list(CONFIGS[name])
    if "--kd_flag" in flags:
        i = flags.index("--kd_flag")
        del flags[i:i + 2]
    return flags


def evaluate(args, name: str, ckpt: str, log_file: str, extra=()) -> dict:
    out = run_cli("det.test_codet", ["--data", os.path.join(args.root, "val"), *test_flags(name),
                                      "--resume", ckpt, "--grid", str(args.grid), "--batch", "4",
                                      "--device", args.device, *extra], log_file, args.inprocess)
    m = AVG_RE.search(out)
    if not m:
        raise RuntimeError(f"no mAP table in the test output (see {log_file})")
    return {"mAP@0.5": float(m.group(1)), "mAP@0.7": float(m.group(2)),
            "n_gt": int(m.group(3)), "n_det": int(m.group(4))}


def run_cell(args, name: str, seed: int, results: dict) -> None:
    key = f"{name}/seed{seed}"
    if key in results:
        print(f"[skip] {key}", flush=True)
        return
    logpath, _ = cell_dirs(args, name, seed)
    os.makedirs(logpath, exist_ok=True)
    log_file = os.path.join(logpath, f"{name}.log")
    t0 = time.perf_counter()
    seconds = {}
    if train(args, name, seed, log_file):
        seconds["train_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    kind = "best" if args.save_best else "final"
    cell = evaluate(args, name, measured_ckpt(args, name, seed, results), log_file)
    if args.save_best:  # the final checkpoint beside the best
        cell.update(best_ckpt_stats(log_file))
        cell["final"] = evaluate(args, name, final_ckpt(args, name, seed), log_file)
    seconds["eval_s"] = time.perf_counter() - t1
    seconds["wall_s"] = time.perf_counter() - t0
    cell.update(epoch_loss_stats(log_file))
    cell["prov"] = stamp(args, CONFIGS[name], seconds, kind)
    record(args.out, key, cell, results)
    print(f"[done] {key}: {cell}", flush=True)


def run_track(args, base: str, seed: int, results: dict) -> None:
    """``test_codet --tracking`` -> ``sort`` -> ``eval_mot`` on a trained
    cell's checkpoint, in a tracking log path of the config's own (``disco``
    and ``disco_kd`` dump under the same mode directory)."""
    key = f"{base}+track/seed{seed}"
    if key in results:
        print(f"[skip] {key}", flush=True)
        return
    ckpt = measured_ckpt(args, base, seed, results)
    if not os.path.exists(ckpt):
        print(f"[miss] {key}: no {ckpt}", flush=True)
        return
    logpath, _ = cell_dirs(args, base, seed)
    log_file = os.path.join(logpath, f"{base}+track.log")
    t0 = time.perf_counter()
    kind = "best" if ckpt == best_ckpt(args, base, seed) else "final"
    cell = track(args, base, ckpt, log_file, os.path.join(logpath, "track", base))
    if kind == "best":  # the final checkpoint beside the best, as the cell
        cell["final"] = track(args, base, final_ckpt(args, base, seed), log_file,
                              os.path.join(logpath, "track_final", base))
    cell["prov"] = stamp(args, CONFIGS[base], {"wall_s": time.perf_counter() - t0}, kind)
    record(args.out, key, cell, results)
    print(f"[done] {key}: {results[key]}", flush=True)


def track(args, base: str, ckpt: str, log_file: str, track_logpath: str) -> dict:
    """{MOTA, MOTP} of ``test_codet --tracking`` -> ``sort`` -> ``eval_mot``
    on ``ckpt``, the dumps under ``track_logpath``."""
    mode = "disco" if base.startswith("disco") else base
    evaluate(args, base, ckpt, log_file, ["--tracking", "--split", "val", "--logpath", track_logpath])
    dumps = os.path.join(track_logpath, mode, "with_rsu", "val", "det_dumps")
    tracks = os.path.join(os.path.dirname(dumps), "tracks")
    run_cli("track.sort", ["--det_logs_path", dumps, "--out", tracks], log_file, args.inprocess)
    out = run_cli("track.eval_mot", ["--data", os.path.join(args.root, "val"), "--tracks", tracks,
                                     "--grid", str(args.grid)], log_file, args.inprocess)
    m = MOT_AVG_RE.search(out)
    if not m:
        raise RuntimeError(f"no CLEAR-MOT avg row in {log_file}")
    return {"MOTA": float(m.group(1)), "MOTP": float(m.group(2))}


def run_extra(args, name: str, seed: int, results: dict) -> None:
    """The eval-only row ``name`` of ``EXTRA_EVALS`` at ``seed``: its base
    config's measured checkpoint, trained first where it is gone (that
    training writes no cell), evaluated with the row's extra flags."""
    key = f"{name}/seed{seed}"
    if key in results:
        print(f"[skip] {key}", flush=True)
        return
    base, extra = EXTRA_EVALS[name]
    logpath, _ = cell_dirs(args, base, seed)
    os.makedirs(logpath, exist_ok=True)
    log_file = os.path.join(logpath, f"{name}.log")
    t0 = time.perf_counter()
    ckpt = measured_ckpt(args, base, seed, results)
    seconds = {}
    if not os.path.exists(ckpt) and train(args, base, seed, os.path.join(logpath, f"{base}.log")):
        seconds["train_s"] = time.perf_counter() - t0
    cell = evaluate(args, base, ckpt, log_file, extra)
    seconds["wall_s"] = time.perf_counter() - t0
    kind = "best" if ckpt == best_ckpt(args, base, seed) else "final"
    cell["prov"] = {**stamp(args, CONFIGS[base] + extra, seconds, kind), "base": base}
    record(args.out, key, cell, results)
    print(f"[done] {key}: {cell}", flush=True)


def generate(args) -> None:
    """The protocol's splits, skipped where they already exist."""
    for split, scenes in (("train", args.train_scenes), ("val", args.val_scenes)):
        out = os.path.join(args.root, split)
        if os.path.isdir(out) and os.listdir(out):
            continue
        os.makedirs(args.root, exist_ok=True)
        run_cli("det.create_data_det", ["--data", args.root, "--split", split, "--scenes", str(scenes),
                                        "--frames", str(args.frames), "--grid", str(args.grid),
                                        "--occlusion", str(args.occlusion)],
                os.path.join(args.root, "gen.log"), args.inprocess)


def ordering_stats(hi, lo) -> dict:
    """The gap of two seed samples' means against their combined noise, as
    the JAX package's harness judges an ordering (its
    ``tools/_bench_harness.py::ordering_stats``): SIGNIFICANT when |gap|
    exceeds sqrt(std_hi^2 + std_lo^2), population stds; with fewer than 2
    seeds on a side there is no noise estimate and no verdict."""
    hi, lo = np.asarray(hi, dtype=np.float64), np.asarray(lo, dtype=np.float64)
    gap = float(np.mean(hi) - np.mean(lo))
    n_hi, n_lo = len(hi), len(lo)
    if n_hi < 2 or n_lo < 2:
        return {"gap": gap, "noise": None, "n_hi": n_hi, "n_lo": n_lo, "verdict": "no verdict (n<2)"}
    noise = float(np.sqrt(np.std(hi) ** 2 + np.std(lo) ** 2))
    return {"gap": gap, "noise": noise, "n_hi": n_hi, "n_lo": n_lo,
            "verdict": "SIGNIFICANT" if abs(gap) > noise else "within noise"}


def welch_test(hi, lo, alpha: float = 0.05) -> dict:
    """Welch's t-test of the gap of two seed samples' means: the gap over
    its standard error sqrt(s_hi^2/n_hi + s_lo^2/n_lo) (sample stds, ddof
    1), Welch-Satterthwaite degrees of freedom, two-sided p. Beside
    :func:`ordering_stats`, whose noise is one seed's spread and does not
    shrink as seeds are added: this error does. SIGNIFICANT when p <
    ``alpha``; with fewer than 2 seeds on a side, no verdict."""
    from scipy import stats

    hi, lo = np.asarray(hi, dtype=np.float64), np.asarray(lo, dtype=np.float64)
    gap = float(np.mean(hi) - np.mean(lo))
    n_hi, n_lo = len(hi), len(lo)
    if n_hi < 2 or n_lo < 2:
        return {"gap": gap, "t": None, "df": None, "p": None, "verdict": "no verdict (n<2)"}
    v_hi, v_lo = np.var(hi, ddof=1) / n_hi, np.var(lo, ddof=1) / n_lo
    if v_hi + v_lo == 0.0:  # both samples constant: the gap is exact
        t = 0.0 if gap == 0.0 else float(np.copysign(np.inf, gap))
        df, p = float(n_hi + n_lo - 2), float(gap == 0.0)
    else:
        t = gap / float(np.sqrt(v_hi + v_lo))
        df = float((v_hi + v_lo) ** 2 / (v_hi ** 2 / (n_hi - 1) + v_lo ** 2 / (n_lo - 1)))
        p = float(2 * stats.t.sf(abs(t), df))
    return {"gap": gap, "t": t, "df": df, "p": p, "verdict": "SIGNIFICANT" if p < alpha else "not significant"}


def mean_std(vals) -> str:
    """'mean +/- std (n)' of a seed sample, the population std."""
    v = np.asarray(list(vals), dtype=np.float64)
    return f"{v.mean():.4f} +/- {v.std():.4f} (n={len(v)})"


def summarize(results: dict, reference: dict, metrics=None) -> list:
    """Print each config's port cells beside the JAX matrix's cells of the
    same key, with the JAX seeds' range; returns the rows. A port value
    outside the range by more than the range's width is flagged. Below each
    row, the port's and JAX's mean +/- std, :func:`ordering_stats` of the
    port's seeds against JAX's (the row's ``ordering``) and
    :func:`welch_test` of the same (its ``welch``). ``metrics``:
    the metrics of every config (default: mAP@0.5 and mAP@0.7, MOTA and
    MOTP for the tracking rows)."""
    rows = []
    names = sorted({k.split("/")[0] for k in results if "/seed" in k})
    print(f"\n{'config':<18} {'metric':<8} {'port (seeds)':<30} {'JAX (seeds)':<30} {'JAX range':<17} verdict")
    for name in names:
        names_metrics = metrics or (("MOTA", "MOTP") if name.endswith("+track") else ("mAP@0.5", "mAP@0.7"))
        for metric in names_metrics:
            port = {k.split("/seed")[1]: v[metric] for k, v in results.items()
                    if k.split("/")[0] == name and metric in v}
            ref = [v[metric] for k, v in reference.items() if k.split("/")[0] == name and metric in v]
            verdict, lo, hi = "no JAX cells", None, None
            if ref:
                lo, hi = min(ref), max(ref)
                off = max(max(lo - x, x - hi, 0.0) for x in port.values())
                width = hi - lo
                verdict = ("inside the range" if off == 0 else
                           f"outside by {off:.4f} (width {width:.4f})" + (" FAULT" if off > width else ""))
            fmt = lambda vals: ", ".join(f"{v:.4f}" for v in vals)  # noqa: E731
            print(f"{name:<18} {metric:<8} {fmt(port[s] for s in sorted(port)):<30} {fmt(sorted(ref)):<30} "
                  + (f"[{lo:.4f}, {hi:.4f}]" if ref else "-").ljust(17) + f" {verdict}")
            row = {"config": name, "metric": metric, "port": port, "jax": ref, "verdict": verdict}
            if ref:
                st = row["ordering"] = ordering_stats(list(port.values()), ref)
                w = row["welch"] = welch_test(list(port.values()), ref)
                noise = "-" if st["noise"] is None else f"{st['noise']:.4f}"
                welch = "" if w["p"] is None else f"t {w['t']:+.2f} (df {w['df']:.1f}), p {w['p']:.3f} "
                print(f"{'':<18} {'':<8} port {mean_std(port.values())}, JAX {mean_std(ref)}: "
                      f"gap {st['gap']:+.4f}, noise {noise} -> {st['verdict']}; Welch {welch}-> {w['verdict']}")
            rows.append(row)
    return rows


def seed_values(results: dict, name: str, metric: str) -> list:
    """``metric`` of every seed of the config ``name``, in seed order."""
    cells = {int(k.split("/seed")[1]): v for k, v in results.items()
             if "/seed" in k and k.split("/")[0] == name and metric in v}
    return [cells[s][metric] for s in sorted(cells)]


def summarize_orderings(results: dict) -> list:
    """Print ``ORDERINGS`` (mAP@0.5 and mAP@0.7) and ``TRACK_ORDERINGS``
    (MOTA) between the port's configs whose cells exist: each side's mean
    and seeds, :func:`ordering_stats` and :func:`welch_test`; returns the
    rows."""
    rows = []
    pairs = [(hi, lo, m) for hi, lo in ORDERINGS for m in ("mAP@0.5", "mAP@0.7")]
    pairs += [(hi, lo, "MOTA") for hi, lo in TRACK_ORDERINGS]
    printed = False
    for hi, lo, metric in pairs:
        a, b = seed_values(results, hi, metric), seed_values(results, lo, metric)
        if not (a and b):
            continue
        if not printed:
            print(f"\n{'ordering (port)':<38} {'metric':<8} hi (seeds) vs lo (seeds): ordering_stats; Welch")
            printed = True
        st, w = ordering_stats(a, b), welch_test(a, b)
        noise = "-" if st["noise"] is None else f"{st['noise']:.4f}"
        p = "-" if w["p"] is None else f"{w['p']:.3g}"
        print(f"{hi + ' > ' + lo:<38} {metric:<8} {mean_std(a)} vs {mean_std(b)}: gap {st['gap']:+.4f}, "
              f"noise {noise} -> {st['verdict']}; Welch p {p} -> {w['verdict']}")
        rows.append({"hi": hi, "lo": lo, "metric": metric, "n_hi": len(a), "n_lo": len(b),
                     "ordering": st, "welch": w})
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description="Detection-quality protocol of the PyTorch port")
    p.add_argument("--root", type=str, default="build/quality", help="data and logs")
    p.add_argument("--out", type=str, default="results/port_occluded_matrix.json")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--configs", type=str, nargs="+", default=["disco", "lowerbound"], choices=sorted(CONFIGS))
    p.add_argument("--nepoch", type=int, default=100)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps_per_dispatch", type=int, default=8,
                   help="train_codet's optimizer steps per dispatch (the JAX matrix trained with 8)")
    p.add_argument("--grid", type=int, default=64)
    p.add_argument("--train_scenes", type=int, default=24)
    p.add_argument("--val_scenes", type=int, default=24)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--occlusion", type=int, default=1)
    p.add_argument("--track_evals", action="store_true",
                   help="after the cells, the tracking rows of the configs in TRACK_EVALS")
    p.add_argument("--extra_evals", action="store_true",
                   help="only the eval-only rows of EXTRA_EVALS over the trained checkpoints of their bases")
    p.add_argument("--save_best", type=int, default=0,
                   help="1: measure the lowest end-of-epoch loss's checkpoint (best.pth), the final one beside "
                        "it; 0 (default): the final checkpoint")
    p.add_argument("--max_pos", type=int, default=0,
                   help="train_codet's --max_pos (the packed loss's positive anchors; 0 = the config's 2048)")
    p.add_argument("--summarize", action="store_true", help="only print the table against the JAX matrix")
    p.add_argument("--commit", type=str, default="", help="stamped on each cell (default: git HEAD)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--inprocess", action="store_true", help="run the CLIs in this process")
    args = p.parse_args(argv)

    results = load_results(args.out)
    if args.summarize:
        return report(results)
    args.card = card() if args.device == "cuda" else args.device
    args.commit = args.commit or git_commit()
    args.source_sha1 = source_digest()
    print(f"card: {args.card}; commit {args.commit}, sources {args.source_sha1}", flush=True)
    generate(args)
    if args.extra_evals:
        for seed in args.seeds:
            for name in EXTRA_EVALS:
                run_extra(args, name, seed, results)
        return report(results)
    # upperbound first: a KD cell's teacher is its seed's upperbound
    order = sorted(args.configs, key=lambda c: c != "upperbound")
    for seed in args.seeds:
        for name in order:
            run_cell(args, name, seed, results)
        if args.track_evals:
            for base in (c for c in TRACK_EVALS if c in args.configs):
                run_track(args, base, seed, results)
    return report(results)


def report(results: dict) -> list:
    """The table against the JAX matrix, then the orderings; returns the
    table's rows."""
    rows = summarize(results, load_results(JAX_MATRIX))
    summarize_orderings(results)
    return rows


if __name__ == "__main__":
    main()
