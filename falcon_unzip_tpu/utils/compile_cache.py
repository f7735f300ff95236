"""Persistent XLA compilation cache.

Every distinct device-program shape pays a compile.  JAX's persistent
compilation cache keeps the compiled executables on disk, so a later
process with the same programs skips straight to execution.  The
reference has no analogue (its native binaries are AOT-compiled); for a
JIT-compiled framework the cache is the AOT story.

Directory rule:
  * ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and no other
    directory is set in code;
  * unset: a fixed directory inside the checkout,
    ``<checkout>/.jax_cache/xla-<host tag>`` (git-ignored).  The path is
    part of what makes a later process find the entries, so it never
    holds a temporary name, a process id or a time.

``enable`` is called once per process, by the entry point
(``falcon_unzip_tpu.cli.main``) or a measurement script, before the
first compile: JAX initializes its cache lazily on first use and ignores
later directory changes.
"""
from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _host_tag() -> str:
    """8-hex fingerprint of the host CPU's feature flags.

    XLA:CPU entries are AOT-compiled FOR THE COMPILING MACHINE; loading
    an entry produced on a host with different vector extensions makes
    XLA warn about possible SIGILL and can change float contraction
    enough to flip low-margin consensus columns.  Salting the cache path
    with the feature set makes a foreign host's entries invisible
    instead of subtly wrong."""
    import hashlib
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags"):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    return hashlib.sha256(feats.encode()).hexdigest()[:8]
    except OSError:
        pass
    import platform
    return hashlib.sha256(
        (platform.machine() + platform.processor()).encode()
    ).hexdigest()[:8]


def cache_dir(environ=os.environ) -> str:
    """The cache directory under the rule above."""
    return environ.get(ENV) or os.path.join(CHECKOUT, ".jax_cache",
                                            f"xla-{_host_tag()}")


def enable() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    import jax
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every entry: small helper programs around the DP and HMM
    # kernels also add compile latency on re-runs
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    logger.info("persistent compile cache at %s", path)
    return path
