from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.core.wdbx import WDBX

__all__ = ["WDBX", "WDBXConfig"]
