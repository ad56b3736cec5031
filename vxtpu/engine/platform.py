"""Platform discovery + startup validation.

The reference's ``CLCaster::init``/``validate`` queries OpenCL platforms,
checks version >= 1.2 and GL-sharing support, and refuses to start on
unsupported devices (SURVEY.md §3 C5, §6 "Failure detection"). Here:
enumerate jax devices, check the scene fits one device's memory, check the
mesh shape against available devices, and fail fast with actionable
messages. Also enables the persistent XLA compilation cache, so a second
process with the same shapes skips compilation.
"""

from __future__ import annotations

import dataclasses
import os

import jax

from vxtpu.utils import tree_bytes

# <repo>/.jax_cache: a fixed path, because the path is part of the cache key
_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compilation_cache_dir() -> str | None:
    """Where the program puts its compile cache: None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads that variable itself),
    else ``<repo>/.jax_cache``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _REPO_CACHE


def enable_compilation_cache() -> None:
    """Persist compiled executables across processes (idempotent)."""
    path = compilation_cache_dir()
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def device_memory_bytes(device=None) -> int:
    """Memory one device can hold, as its runtime reports it
    (``memory_stats()["bytes_limit"]``). A device that reports none is an
    error: there is no table of guesses to fall back on."""
    device = device or jax.devices()[0]
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError(
            f"device {device.device_kind!r} ({device.platform}) reports no "
            "memory limit; cannot check that the scene fits")
    return int(stats["bytes_limit"])


@dataclasses.dataclass(frozen=True)
class PlatformInfo:
    backend: str
    device_kind: str
    num_devices: int
    num_hosts: int


def platform_info() -> PlatformInfo:
    devs = jax.devices()
    return PlatformInfo(
        backend=jax.default_backend(),
        device_kind=devs[0].device_kind,
        num_devices=len(devs),
        num_hosts=jax.process_count(),
    )


def platform_report() -> dict:
    """JSON-friendly platform summary for the CLI ``info`` subcommand."""
    return dict(dataclasses.asdict(platform_info()),
                memory_bytes=device_memory_bytes())


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> PlatformInfo:
    """Join the multi-host SPMD runtime (``jax.distributed.initialize``) —
    the reference has no distribution at all (SURVEY.md §3 "Parallelism
    table": the rebuild adds multi-host).

    With no arguments, jax auto-detects the cluster from the environment;
    explicit args support manual clusters. Idempotent: safe to call when
    already initialized.

    Failure semantics (a silent fallback here would let every host train a
    divergent local-only replica and report success): only two outcomes are
    swallowed — "already initialized" (idempotence) and "no cluster
    detected" when auto-detecting (the legitimate single-process path, and
    then only if the environment really looks single-process). Any other
    initialize() failure re-raises.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError) as e:
        msg = str(e).lower()
        if "already" in msg:  # idempotent re-entry
            return platform_info()
        auto_detect = (coordinator_address is None and num_processes is None
                       and process_id is None)
        no_cluster = ("could not find" in msg or "unable to" in msg
                      or "cannot" in msg or "not set" in msg
                      or "auto-detect" in msg or "autodetect" in msg
                      or isinstance(e, ValueError))
        if auto_detect and no_cluster and jax.process_count() <= 1:
            # genuine single-process run: initialize() has nothing to join
            return platform_info()
        raise RuntimeError(
            "jax.distributed.initialize() failed — refusing to continue "
            "as independent single-host replicas (each would train a "
            f"divergent copy and report success): {e}"
        ) from e
    return platform_info()


def validate_platform(scene_tree=None, mesh_devices: int | None = None,
                      headroom: float = 0.75) -> PlatformInfo:
    """Fail fast before any compile: the scene must fit one device's memory
    (the grid is replicated on every device), and the requested mesh must
    not exceed available devices."""
    info = platform_info()
    if mesh_devices is not None and mesh_devices > info.num_devices:
        raise RuntimeError(
            f"requested mesh of {mesh_devices} devices but only "
            f"{info.num_devices} present ({info.device_kind})"
        )
    if scene_tree is not None:
        need = tree_bytes(scene_tree)
        budget = int(device_memory_bytes() * headroom)
        if need > budget:
            raise RuntimeError(
                f"scene needs {need/1e9:.2f} GB but the per-device budget is "
                f"{budget/1e9:.2f} GB ({info.device_kind}); shrink the grid "
                "or drop per-voxel attributes"
            )
    return info
