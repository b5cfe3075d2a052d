from repro_torch.data.partition import gaussian_k_schedule, iid_partition
from repro_torch.data.pipeline import FederatedBatcher, LMFederatedBatcher
from repro_torch.data.synthetic import (Dataset, fedprox_synthetic,
                                        lm_sequences, token_stream)

__all__ = ["Dataset", "FederatedBatcher", "LMFederatedBatcher",
           "fedprox_synthetic", "gaussian_k_schedule", "iid_partition",
           "lm_sequences", "token_stream"]
