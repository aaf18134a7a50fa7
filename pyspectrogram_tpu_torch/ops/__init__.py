"""Device compute ops of the port (torch)."""
