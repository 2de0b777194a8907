"""System abstraction: host info, memory, files (L0 equivalent).

The reference's system layer (src/gatb/system: IFileSystem, IThread,
IMemory, ISystemInfo) abstracts the OS for C++; here Python's stdlib
plays that role, and this module provides the introspection surface the
algorithms and info dumps use (ISystemInfo.hpp:41-79 equivalents).

Port of gatb_core_tpu/system/info.py. Where the JAX package reports JAX
and its devices, this one reports torch, its CUDA version and the CUDA
cards by name (an empty list without a card: the CPU is not reported as
a device); ``library_info``'s version string is the port's own.
"""

from __future__ import annotations

import os
import platform
import shutil
import tempfile
import time


class SystemInfo:
    """ISystemInfo equivalents (nb cores, RAM, build info)."""

    @staticmethod
    def nb_cores() -> int:
        return os.cpu_count() or 1

    @staticmethod
    def memory_physical_total_mb() -> int:
        try:
            pages = os.sysconf("SC_PHYS_PAGES")
            page_size = os.sysconf("SC_PAGE_SIZE")
            return pages * page_size // (1 << 20)
        except (ValueError, OSError):  # pragma: no cover
            return 0

    @staticmethod
    def memory_self_used_mb() -> float:
        try:
            import resource

            return resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024.0
        except Exception:  # pragma: no cover
            return 0.0

    @staticmethod
    def memory_project_mb() -> int:
        """Default memory budget: 2/3 of physical like the reference's
        docker-safe clamp (ConfigurationAlgorithm.cpp:336-345)."""
        total = SystemInfo.memory_physical_total_mb()
        return min(5000, (total * 2) // 3) if total else 5000

    @staticmethod
    def version_info() -> dict:
        import torch

        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        return {
            "os": platform.system(),
            "machine": platform.machine(),
            "python": platform.python_version(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "devices": [torch.cuda.get_device_name(i) for i in range(cards)],
        }


def host_info() -> dict:
    """HostInfo properties block (tools/misc/impl/HostInfo.hpp): host
    name, cores, physical/used memory — merged into tool info trees."""
    return {
        "chost_name": platform.node(),
        "chome_directory": os.path.expanduser("~"),
        "cnb_cores": SystemInfo.nb_cores(),
        "cmemory_total_mb": SystemInfo.memory_physical_total_mb(),
        "cmemory_used_mb": round(SystemInfo.memory_self_used_mb(), 1),
    }


def library_info() -> dict:
    """LibraryInfo properties block (tools/misc/impl/LibraryInfo.hpp):
    version/build metadata, the 'gatb-core-library' info the reference
    stamps into every .h5 (Graph.cpp root xml)."""
    info = {
        "version": "2.0-torch-cuda",
        "build_system": f"{platform.system()}-{platform.release()}",
        "build_compiler": f"python {platform.python_version()}",
        "kmer_sizes": "any (uint32 limb arrays; no compiled span list)",
    }
    info.update(SystemInfo.version_info())
    info.pop("devices", None)
    return info


class FileSystem:
    """IFileSystem equivalents."""

    @staticmethod
    def available_space_mb(path: str = ".") -> int:
        usage = shutil.disk_usage(path)
        return usage.free // (1 << 20)

    @staticmethod
    def temp_filename(prefix: str = "gatb") -> str:
        fd, path = tempfile.mkstemp(prefix=prefix)
        os.close(fd)
        return path

    @staticmethod
    def max_files_number() -> int:
        try:
            import resource

            soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
            return soft
        except Exception:  # pragma: no cover
            return 1024
