"""Port of arendur_tpu.filming."""
