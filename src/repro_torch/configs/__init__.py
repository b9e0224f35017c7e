"""FEEL round configuration (the paper's Table I)."""
