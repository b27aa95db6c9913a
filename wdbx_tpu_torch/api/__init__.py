from wdbx_tpu_torch.api.server import WDBXAPIServer

__all__ = ["WDBXAPIServer"]
