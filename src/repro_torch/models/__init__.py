"""The paper's 2-layer MNIST MLP, the LM task's dense transformer and the
decoder-only model zoo (dense, vlm and ssm families) with its serving
API."""
