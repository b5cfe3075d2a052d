from repro_torch.data.partition import gaussian_k_schedule, iid_partition
from repro_torch.data.pipeline import FederatedBatcher
from repro_torch.data.synthetic import Dataset, fedprox_synthetic

__all__ = ["Dataset", "FederatedBatcher", "fedprox_synthetic",
           "gaussian_k_schedule", "iid_partition"]
