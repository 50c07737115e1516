"""Box codec, voxelizer, rotated IoU, NMS, late fusion and pose warp of the port."""
