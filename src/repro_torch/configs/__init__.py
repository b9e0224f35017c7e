"""FEEL round configuration (the paper's Table I) and the model configs
of the LM task and the decoder-only zoo."""
