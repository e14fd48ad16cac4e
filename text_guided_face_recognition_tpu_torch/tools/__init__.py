"""Command-line checks of the port, run as modules (`python -m ...`)."""
