from repro_torch.core.baselines.fedavg import (FedAvgTrainer,
                                               make_fedavg_round_step)
from repro_torch.core.baselines.fedbuff import FedBuffTrainer
from repro_torch.core.baselines.sfl_family import (SFLTrainer,
                                                   make_sfl_round_step)

__all__ = ["SFLTrainer", "make_sfl_round_step", "FedAvgTrainer",
           "make_fedavg_round_step", "FedBuffTrainer"]
