from .interface import ErasureCodeInterface, ErasureCodeProfile
from .base import (DEVICE_THRESHOLD_BYTES, CHUNK_ALIGN, SIMD_ALIGN,
                   DeviceRouting, ErasureCode)
from .registry import (ErasureCodePlugin, ErasureCodePluginRegistry,
                       default_registry)

__all__ = ["ErasureCodeInterface", "ErasureCodeProfile", "ErasureCode",
           "DeviceRouting", "DEVICE_THRESHOLD_BYTES",
           "SIMD_ALIGN", "CHUNK_ALIGN", "ErasureCodePlugin",
           "ErasureCodePluginRegistry", "default_registry"]
