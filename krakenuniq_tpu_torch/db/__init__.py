from .device_db import DeviceDB, load_database_dir
from .pool import ValuePool, build_value_pool

__all__ = ["DeviceDB", "load_database_dir", "ValuePool", "build_value_pool"]
