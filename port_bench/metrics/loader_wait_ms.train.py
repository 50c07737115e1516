"""Host ms a step of the timed window waits on the prefetch iterator
(``training.prefetch_to_device``) for its batch, the mean over the window."""


def read(r):
    waits = r.get("loader_wait_s")
    if r.get("kind") != "train" or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
