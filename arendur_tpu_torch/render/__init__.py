"""Port of arendur_tpu.render."""
