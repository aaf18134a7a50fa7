"""The benchmark harness of pyspectrogram_tpu_torch (see ../README.md)."""
