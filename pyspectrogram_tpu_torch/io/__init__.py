"""Host ingest helpers of the port (the reader itself is the JAX package's
jax-free pyspectrogram_tpu.io)."""
