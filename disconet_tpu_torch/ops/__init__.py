"""Box codec, voxelizer, rotated IoU, NMS and pose warp of the port."""
