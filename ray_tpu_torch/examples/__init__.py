"""Model constructors shared by the examples and `chip_smoke.py`."""
