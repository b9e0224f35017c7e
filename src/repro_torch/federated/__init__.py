"""The FEEL round (Algorithm 1): local training, evaluation, FedAvg;
the experiment and sweep drivers. The public names are the JAX
package's ``repro.federated.__all__``."""
from repro_torch.federated.aggregation import (fedavg, fedavg_stacked,
                                               normalize_weights)
from repro_torch.federated.client import ClientReport, local_train
from repro_torch.federated.cohort import cohort_eval, cohort_train
from repro_torch.federated.server import (CohortData, FeelServer, RoundLog,
                                          build_cohort_data)
from repro_torch.federated.simulation import (SweepResult, averaged,
                                              run_experiment, run_sweep)
from repro_torch.federated.task import (TASKS, FeelTask, LmTask, MnistTask,
                                        as_task)

__all__ = ["fedavg", "fedavg_stacked", "normalize_weights", "ClientReport",
           "local_train", "cohort_eval", "cohort_train", "CohortData",
           "FeelServer", "RoundLog", "build_cohort_data", "SweepResult",
           "averaged", "run_experiment", "run_sweep", "TASKS", "FeelTask",
           "LmTask", "MnistTask", "as_task"]
