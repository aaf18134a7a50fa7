"""Request pipelines of the port."""
