"""Tensor parallelism over the model axis: not ported yet.

The JAX package (``emotts/parallel/tp.py``) shards the heavy weights over
the model axis with Megatron-style column→row pairs: the FFT blocks'
conv-FFN ``conv1`` splits its output features and ``conv2`` its input
features; the attention's query/key/value split their heads and the output
projection its heads input; everything else is replicated.  Porting it
changes ``nn/blocks.py`` and the attention's heads per rank, and it is the
next step of the port.  Until then a mesh with a model axis is refused.
"""

from __future__ import annotations


def refuse_model_parallel(model_parallel: int) -> None:
    """Raise ``ValueError`` for ``mesh.model_parallel > 1``."""
    if model_parallel > 1:
        raise ValueError(
            f"mesh.model_parallel={model_parallel}: tensor parallelism is not "
            "ported yet (emotts_torch runs data parallelism only); set "
            "mesh.model_parallel to 1")
