"""The plain reference that decides ``correct``: no import of the
program or of JAX."""
