"""The reference's two applications over the port's scheme layer:
encrypted regression (regression.py) and statistics (statistics.py)."""
