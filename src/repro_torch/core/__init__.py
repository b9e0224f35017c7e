"""The paper's contribution: data-quality based scheduling (DQS) for FEEL.

diversity (Eq. 2) + reputation (Eq. 1) -> data-quality value (Eq. 3);
wireless cost model (Eq. 4-7, 9); greedy-knapsack scheduler (Algorithm 2)
with baseline policies; label-flip poisoning (§III-B.1) generalized to a
pluggable threat-model plane (core/attacks.py); a matching defense plane
(core/defenses.py: robust aggregators + validation detection, each with a
host oracle and a batched twin); the batched control plane
(core/control.py) scheduling all runs of a sweep in one call, with the
numpy implementations as the bit-parity oracle.

The public names are the JAX package's ``repro.core.__all__`` but for
two: ``greedy_pack_rows`` is its ``greedy_pack_jnp`` (the sorted walk
over torch rows), and ``normalize`` is not ported (no caller;
``normalize_rows`` and ``normalize_last`` are its batched forms).
"""
from repro_torch.core.attacks import (SCENARIOS, AttackScenario, FeatureNoise,
                                      LabelFlip, MaliciousSchedule,
                                      ModelAttack, NO_ATTACK, ReportAttack,
                                      as_scenario, colluding, feature_noise,
                                      free_rider, intermittent, label_flip,
                                      legacy_scenario, lie_boost, model_poison,
                                      multi_flip, recovery_rounds, register,
                                      reputation_gap)
from repro_torch.core.control import ControlState, finalize_runs, schedule_runs
from repro_torch.core.defenses import (DEFENSES, DefensePolicy, DefenseStats,
                                       Krum, Median, NO_DEFENSE, NormClip,
                                       TrimmedMean, ValidationDetector,
                                       as_defense, detection_stats, krum,
                                       median, norm_clip, trimmed_mean,
                                       validation, with_validation)
from repro_torch.core.diversity import (diversity_index, diversity_index_eq2,
                                        diversity_index_rows, gini_simpson,
                                        normalize_last, normalize_rows)
from repro_torch.core.poisoning import (EASY_PAIR, HARD_PAIR, LabelFlipAttack,
                                        pick_malicious)
from repro_torch.core.quality import adaptive_weights, data_quality_value
from repro_torch.core.reputation import (ReputationTracker,
                                         reputation_update_eq1)
from repro_torch.core.scheduler import (POLICIES, POLICY_IDS, Schedule,
                                        best_channel_schedule,
                                        brute_force_schedule, dqs_schedule,
                                        greedy_pack, greedy_pack_rows,
                                        max_count_schedule, pack_scan,
                                        priority_key, random_schedule,
                                        top_value_schedule)
from repro_torch.core.wireless import (ChannelState, WirelessModel,
                                       cost_bisect, dbm_to_watt, rate_eq4)

__all__ = [
    "SCENARIOS", "AttackScenario", "FeatureNoise", "LabelFlip",
    "MaliciousSchedule", "ModelAttack", "NO_ATTACK", "ReportAttack",
    "as_scenario", "colluding", "feature_noise", "free_rider",
    "intermittent", "label_flip", "legacy_scenario", "lie_boost",
    "model_poison", "multi_flip", "recovery_rounds", "register",
    "reputation_gap",
    "ControlState", "finalize_runs", "schedule_runs",
    "DEFENSES", "DefensePolicy", "DefenseStats", "Krum", "Median",
    "NO_DEFENSE", "NormClip", "TrimmedMean", "ValidationDetector",
    "as_defense", "detection_stats", "krum", "median", "norm_clip",
    "trimmed_mean", "validation", "with_validation",
    "diversity_index", "diversity_index_eq2", "diversity_index_rows",
    "gini_simpson", "normalize_last", "normalize_rows",
    "EASY_PAIR", "HARD_PAIR", "LabelFlipAttack", "pick_malicious",
    "adaptive_weights", "data_quality_value",
    "ReputationTracker", "reputation_update_eq1",
    "POLICIES", "POLICY_IDS", "Schedule", "best_channel_schedule",
    "brute_force_schedule", "dqs_schedule", "greedy_pack",
    "greedy_pack_rows", "max_count_schedule", "pack_scan", "priority_key",
    "random_schedule", "top_value_schedule",
    "ChannelState", "WirelessModel", "cost_bisect", "dbm_to_watt",
    "rate_eq4",
]
