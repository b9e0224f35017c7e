"""The paper's contribution on the host: wireless cost model, Eq. 1-3
quality metrics and the DQS scheduler (Algorithm 2); the threat-model and
defense planes."""
