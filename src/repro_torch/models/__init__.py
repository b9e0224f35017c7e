"""The paper's 2-layer MNIST MLP and the LM task's dense transformer."""
