from dafne_torch.models.build import build_model

__all__ = ["build_model"]
