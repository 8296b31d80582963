"""User examples of the port, each runnable with ``python -m``."""
