"""Port of arendur_tpu.shapes."""
