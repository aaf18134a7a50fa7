"""Clients of the port: the ``pstpu-torch`` CLI and the viewer GUI."""
