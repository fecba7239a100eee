"""Port of arendur_tpu.sampling."""
