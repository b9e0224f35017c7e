"""FEEL round configuration: ``FeelConfig`` (the paper's Table I), the
dBm -> watt conversion its wireless constants share, and ``ModelConfig``,
the transformer configuration of the LM task (``lm_tiny``).

``ModelConfig`` keeps the JAX package's field names. The port runs the
dense family only: the MoE, SSM, MLA, encoder-decoder and multi-token
prediction fields exist so that a config reads as the reference's, but
setting any of them raises ``NotImplementedError`` until the big-model zoo
is ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class FeelConfig:
    """Federated-edge-learning round configuration (the paper's Table I)."""
    n_ues: int = 50               # K
    n_malicious: int = 5
    # Fields of the planes the port does not run yet (population, the
    # defense and LM task planes, async mode) are kept so that a config
    # matches the JAX package's field for field; the port's server raises
    # on any value it cannot run.
    # Candidate population size N; None pins N == K.
    population: Optional[int] = None
    rounds: int = 15              # t_max
    local_epochs: int = 3         # epsilon (paper leaves it unspecified)
    deadline_s: float = 300.0     # T
    bandwidth_hz: float = 1e6     # B
    model_size_bits: float = 100e3 * 8   # s = 100 Ko
    tx_power_dbm: float = -23.0   # P_k
    noise_dbm_hz: float = -174.0  # N0
    pathloss_exp: float = 3.76    # alpha (not given in paper; 3GPP UMa value)
    cell_side_m: float = 500.0
    min_selected: int = 5         # N in Algorithm 1
    # data-quality weights
    omega_rep: float = 0.5        # omega_1
    omega_div: float = 0.5        # omega_2
    gamma: Tuple[float, float, float] = (1 / 3, 1 / 3, 1 / 3)
    eta: float = 1.0              # reputation rate (paper: eta = 1)
    # beta_i are unspecified in the paper; weighted toward the server-side
    # test gap, the stronger poisoning signal (see EXPERIMENTS.md)
    beta1: float = 0.2            # weight of (acc_local - avg_acc)
    beta2: float = 0.8            # weight of (acc_local - acc_test)
    recovery_threshold: float = 0.5
    defense: str = "none"
    task: str = "mnist_mlp"
    mode: str = "sync"
    async_buffer: Optional[int] = None
    async_deadline: Optional[float] = None
    async_staleness: float = 0.5
    async_latency_scale: float = 1.0
    # AR(1)/Gauss-Markov small-scale fading correlation rho across
    # consecutive channel draws (core/wireless.py): 0.0 keeps the legacy
    # memoryless Rayleigh draw bit-for-bit; rho in (0, 1) gives each UE
    # persistent block-fading state with stationary |h|^2 ~ Exp(1).
    channel_corr: float = 0.0
    # client compute model (Eq. 6). zeta/f are unspecified in the paper;
    # calibrated so t_train spans [~1s, ~375s] against T=300s — large datasets
    # on slow UEs can blow the deadline, which is exactly the paper's
    # motivation for joint selection + bandwidth allocation.
    cycles_per_bit: float = 2e3   # zeta_k
    cpu_hz_min: float = 5e7       # f_k drawn uniformly in [min, max]
    cpu_hz_max: float = 5e8
    sample_bits: float = 28 * 28 * 8

    # Derived linear-scale wireless constants: Eq. 4/9 read the dBm -> watt
    # conversion from here, once.
    @property
    def n_population(self) -> int:
        """Candidate population size N (defaults to the budget K)."""
        n = self.population if self.population is not None else self.n_ues
        assert n >= self.n_ues, (
            f"population {n} smaller than the bandwidth budget K="
            f"{self.n_ues}")
        return n

    @property
    def p_watt(self) -> float:
        """Uplink transmit power P_k in watts."""
        return dbm_to_watt(self.tx_power_dbm)

    @property
    def n0_watt_hz(self) -> float:
        """Noise power spectral density N0 in W/Hz."""
        return dbm_to_watt(self.noise_dbm_hz)


def dbm_to_watt(dbm: float) -> float:
    return 10.0 ** (dbm / 10.0) / 1000.0


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-only transformer: pre-norm layers of GQA attention (RoPE,
    optional sliding window) and a SwiGLU MLP, stacked in ``n_blocks``
    super-blocks of ``block_len`` layers."""
    name: str
    family: str                   # only "dense" runs in the port
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    head_dim: int = 0             # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    norm_eps: float = 1e-5
    sliding_window: Optional[int] = None
    long_context_window: Optional[int] = None

    # planes of the big-model zoo (not ported: any non-default raises)
    moe: Optional[object] = None
    moe_layer_period: int = 1
    first_dense_layers: int = 0
    ssm: Optional[object] = None
    attn_layer_period: int = 0
    attn_layer_offset: int = 4
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    frontend: str = "none"
    mla: Optional[object] = None
    mtp: bool = False

    dtype: str = "bfloat16"
    block_len: int = 0            # 0 -> derived (1 for the dense family)
    scan_unroll: int = 1

    _ZOO = (("moe", None), ("first_dense_layers", 0), ("ssm", None),
            ("attn_layer_period", 0), ("encoder_layers", 0),
            ("is_encoder_decoder", False), ("frontend", "none"),
            ("mla", None), ("mtp", False))

    def __post_init__(self):
        if self.family != "dense":
            raise NotImplementedError(
                f"{self.name}: the {self.family!r} family is not ported; "
                "the port runs the dense family")
        for field, default in self._ZOO:
            if getattr(self, field) != default:
                raise NotImplementedError(
                    f"{self.name}: {field}={getattr(self, field)!r} is not "
                    "ported; the port runs the dense family")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.block_len == 0:
            object.__setattr__(self, "block_len", 1)
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads {self.n_heads} is not a "
                             f"multiple of n_kv_heads {self.n_kv_heads}")

    @property
    def scanned_layers(self) -> int:
        return self.n_layers - self.first_dense_layers

    @property
    def n_blocks(self) -> int:
        if self.scanned_layers % self.block_len:
            raise ValueError(f"{self.name}: {self.scanned_layers} layers not "
                             f"divisible by block_len {self.block_len}")
        return self.scanned_layers // self.block_len

    def layer_kind(self, idx_in_block: int) -> dict:
        """Sub-layer ``idx_in_block`` of a super-block: attention mixer and
        dense MLP, the only kind of the dense family."""
        return {"mixer": "attn", "mlp": "dense"}

    def block_pattern(self) -> Tuple[dict, ...]:
        return tuple(self.layer_kind(i) for i in range(self.block_len))

    def param_count(self) -> int:
        """Parameters of the dense LM: embedding and head (untied), per
        layer the attention projections, the SwiGLU MLP and two norm
        scales, and the final norm."""
        d, hd = self.d_model, self.head_dim
        attn = d * self.n_heads * hd * 2 + 2 * d * self.n_kv_heads * hd
        layer = attn + 3 * d * self.d_ff + 2 * d
        return 2 * self.vocab_size * d + self.n_layers * layer + d
