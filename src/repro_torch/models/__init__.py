from repro_torch.models.registry import get_model

__all__ = ["get_model"]
