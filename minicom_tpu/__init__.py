"""minicom_tpu — lossless short-read (FASTQ) compressor on JAX.

A from-scratch JAX/XLA reimplementation of the capabilities of the
reference compressor (yuansliu/minicom, see /root/reference): minimizer-indexed
contig clustering, suffix-prefix contig merging, dictionary-based singleton
realignment, diff-stream serialization, and an entropy-coded container — designed
as deterministic sort/scan/segment kernels over fixed-shape device arrays instead
of the reference's pthread/lock/MPHF C++ design.

Modes (reference `minicom:15-33`): single-end unordered (default),
order-preserving (`-p`), paired-end (`-1/-2`); full parameter surface
`-t -k -e -m -w -s -S -E -g -R`.
"""

# Device code is pure 32-bit by convention (see ops/sketch.py): k-mers travel
# as uint32 pairs and only the HOST reassembles them into uint64 sort keys, so
# the package never needs JAX's global jax_enable_x64 switch.

import os as _os

import jax as _jax

# Persistent XLA compile cache: JAX_COMPILATION_CACHE_DIR wins when set (JAX
# reads it itself); otherwise a fixed directory inside the checkout, so every
# process of one checkout finds the programs compiled before.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

__version__ = "0.1.0"

from minicom_tpu.config import CompressorConfig  # noqa: E402,F401
