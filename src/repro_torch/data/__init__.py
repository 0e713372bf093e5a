from repro_torch.data.activation_store import ActivationStore
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.pipeline import (
    ClientData,
    client_pool,
    federate,
    round_batches,
)
from repro_torch.data.synthetic import (
    Dataset,
    make_dataset_for_model,
    make_lm_dataset,
)

__all__ = [
    "ActivationStore", "ClientData", "client_pool", "federate",
    "round_batches", "Dataset", "make_dataset_for_model", "make_lm_dataset",
    "dirichlet_partition",
]
