"""FEEL round configuration: ``FeelConfig`` (the paper's Table I), the
dBm -> watt conversion its wireless constants share, ``ModelConfig`` (the
transformer of the LM task, ``lm_tiny``, and the decoder-only configs of
the big-model zoo), ``SSMConfig`` and the zoo's ``InputShape`` values.

``ModelConfig`` keeps the JAX package's field names. The port runs the
decoder-only families without experts: ``dense``, ``vlm`` (an
early-fusion decoder over token ids, its image frontend a stub) and
``ssm`` (Mamba2). The MoE, hybrid, MLA, encoder-decoder, multi-token
prediction and leading-dense-layer fields exist so that a config reads as
the reference's, but setting any of them raises ``NotImplementedError``
naming the slice of the port that brings it.
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
class SSMConfig:
    """Mamba2 / SSD sub-config."""
    d_state: int = 128            # N
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    n_groups: int = 1             # G (B/C groups)
    conv_kernel: int = 4
    chunk: int = 256              # SSD chunk length Q
    dt_min: float = 0.001
    dt_max: float = 0.1
    # dtype of the reference's materialised intra-chunk decay/score
    # tensors; the port computes them in float32 and takes no other value
    compute_dtype: str = "float32"


_MOE_SLICE = "the MoE slice of the port (K5 moe_gemm)"
_LATER = "a later slice of the port"


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-only language model: pre-norm layers of a mixer (GQA
    attention with RoPE and an optional sliding window, or a Mamba2 SSD
    block) and an MLP (SwiGLU, or none in the SSM family), stacked in
    ``n_blocks`` super-blocks of ``block_len`` layers."""
    name: str
    family: str                   # dense | vlm | ssm run in the port
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                     # dense-MLP hidden width (0 for pure SSM)
    vocab_size: int
    citation: str = ""

    head_dim: int = 0             # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    qk_norm: bool = False         # Chameleon-style query/key RMSNorm
    norm_eps: float = 1e-5
    # ``sliding_window`` applies to every shape (StarCoder2's own);
    # ``long_context_window`` only to sequences past 32,768 tokens on
    # otherwise full-attention archs (``transformer.decode_cache_len``)
    sliding_window: Optional[int] = None
    long_context_window: Optional[int] = None

    # planes of the zoo the port does not run yet (any non-default raises)
    moe: Optional[object] = None
    moe_layer_period: int = 1
    first_dense_layers: int = 0
    ssm: Optional[SSMConfig] = None
    attn_layer_period: int = 0    # hybrid: one attention layer per p layers
    attn_layer_offset: int = 4
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    frontend: str = "none"        # none | vlm (a stub: inputs are token ids)
    mla: Optional[object] = None
    mtp: bool = False

    dtype: str = "bfloat16"
    block_len: int = 0            # 0 -> derived (1 without a hybrid / MoE)
    scan_unroll: int = 1

    # (field, default, the slice that brings it)
    _UNPORTED = (("moe", None, _MOE_SLICE),
                 ("moe_layer_period", 1, _MOE_SLICE),
                 ("attn_layer_period", 0,
                  "the MoE slice of the port (the Jamba hybrid)"),
                 ("first_dense_layers", 0,
                  _LATER + " (DeepSeek's MLA, MTP and leading dense "
                  "layers)"),
                 ("mla", None, _LATER + " (DeepSeek's MLA)"),
                 ("mtp", False, _LATER + " (DeepSeek's MTP head)"),
                 ("encoder_layers", 0, _LATER + " (the encoder-decoder)"),
                 ("is_encoder_decoder", False,
                  _LATER + " (the encoder-decoder)"))
    _FAMILIES = {"dense": "none", "vlm": "vlm", "ssm": "none"}

    def __post_init__(self):
        if self.family not in self._FAMILIES:
            slice_ = (_MOE_SLICE if self.family in ("moe", "hybrid")
                      else _LATER)
            raise NotImplementedError(
                f"{self.name}: the {self.family!r} family is not ported; "
                f"it comes with {slice_}")
        for field, default, slice_ in self._UNPORTED:
            if getattr(self, field) != default:
                raise NotImplementedError(
                    f"{self.name}: {field}={getattr(self, field)!r} is not "
                    f"ported; it comes with {slice_}")
        if self.frontend != self._FAMILIES[self.family]:
            raise NotImplementedError(
                f"{self.name}: frontend={self.frontend!r} with family "
                f"{self.family!r} is not ported (the audio frontend comes "
                f"with {_LATER}, the encoder-decoder)")
        if (self.family == "ssm") != (self.ssm is not None):
            raise NotImplementedError(
                f"{self.name}: an ssm sub-config outside the ssm family is "
                f"the hybrid, which comes with {_MOE_SLICE}"
                if self.ssm is not None else
                f"{self.name}: the ssm family needs an SSMConfig")
        if self.ssm is not None and not isinstance(self.ssm, SSMConfig):
            raise TypeError(f"{self.name}: ssm must be an SSMConfig")
        if self.ssm is not None and self.ssm.compute_dtype != "float32":
            raise NotImplementedError(
                f"{self.name}: ssm.compute_dtype="
                f"{self.ssm.compute_dtype!r} is not ported; the SSD scan "
                f"computes in float32 until {_LATER} brings a lower "
                f"precision")
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
        """Sub-layer ``idx_in_block`` of a super-block: a Mamba2 mixer and
        no MLP in the SSM family, else attention and a dense MLP."""
        if self.family == "ssm":
            return {"mixer": "ssm", "mlp": "none"}
        return {"mixer": "attn", "mlp": "dense"}

    def block_pattern(self) -> Tuple[dict, ...]:
        return tuple(self.layer_kind(i) for i in range(self.block_len))

    def param_count(self) -> int:
        """Analytic parameter count, the reference's for the ported
        families: embedding and head (untied); a layer's mixer, its MLP and
        two norm scales (counted whatever the MLP, as the reference does:
        an SSM layer has one); the final norm."""
        n = 2 * self.vocab_size * self.d_model
        for _ in range(self.n_blocks):
            for kind in self.block_pattern():
                n += self._mixer_params(kind["mixer"]) + 2 * self.d_model
                if kind["mlp"] == "dense":
                    n += 3 * self.d_model * self.d_ff
        return n + self.d_model

    def _mixer_params(self, kind: str) -> int:
        d, hd = self.d_model, self.head_dim
        if kind == "attn":
            return (d * self.n_heads * hd * 2
                    + 2 * d * self.n_kv_heads * hd)
        s = self.ssm
        d_in = s.expand * d
        nh = d_in // s.head_dim
        proj_in = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
        conv = (d_in + 2 * s.n_groups * s.d_state) * s.conv_kernel
        return proj_in + conv + d_in * d + nh * 3 + d_in


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
