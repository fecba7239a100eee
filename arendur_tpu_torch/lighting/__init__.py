"""Port of arendur_tpu.lighting."""
