"""Image textures (port of arendur_tpu/texturing)."""
