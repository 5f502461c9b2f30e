"""Command-line tools of the port (run with `python -m`)."""
