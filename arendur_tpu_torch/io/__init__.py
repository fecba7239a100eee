"""Port of arendur_tpu.io."""
