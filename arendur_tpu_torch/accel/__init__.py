"""Port of arendur_tpu.accel."""
