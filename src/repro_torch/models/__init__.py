from repro_torch.models.model import cross_entropy

__all__ = ["cross_entropy"]
