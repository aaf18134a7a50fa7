"""Display epilogue of the port (uint8 tiles on the device)."""
