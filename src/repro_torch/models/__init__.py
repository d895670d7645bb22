from repro_torch.models.model import forward, init_params

__all__ = ["forward", "init_params"]
