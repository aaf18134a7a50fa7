"""Instrumentation of the port."""
