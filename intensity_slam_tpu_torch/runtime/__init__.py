"""Host runtime: scan-log IO, prefetching, channels, async writers, the
streaming runner and the trajectory spill (the port's own copies over the
repo's `native/` C++ library, which it builds into `_build/`)."""

from . import native  # noqa: F401
from .scanlog import ScanLog, ScanLogWriter, Prefetcher  # noqa: F401
from .channel import Channel  # noqa: F401
from .traj import TrajectoryWriter  # noqa: F401
from .stream import StreamingRunner  # noqa: F401
