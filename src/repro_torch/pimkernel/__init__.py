"""PIM Kernel software layer (paper §2.2): Data Mapper + PIM Executor."""
from .tileconfig import PimDType, TileConfig, ALL_DTYPES  # noqa: F401
