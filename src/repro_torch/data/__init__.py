from repro_torch.data.partition import (dirichlet_partition,
                                       gaussian_k_schedule, iid_partition,
                                       shard_partition)
from repro_torch.data.pipeline import (DeviceBatcher, DeviceLMBatcher,
                                       FederatedBatcher, LMFederatedBatcher,
                                       eval_metric)
from repro_torch.data.synthetic import (Dataset, fedprox_synthetic,
                                        gaussian_classification,
                                        image_classification, lm_sequences,
                                        quadratic_clients, token_stream)

__all__ = ["Dataset", "DeviceBatcher", "DeviceLMBatcher",
           "FederatedBatcher", "LMFederatedBatcher", "eval_metric",
           "dirichlet_partition", "fedprox_synthetic",
           "gaussian_classification", "gaussian_k_schedule",
           "image_classification", "iid_partition", "lm_sequences",
           "quadratic_clients", "shard_partition", "token_stream"]
