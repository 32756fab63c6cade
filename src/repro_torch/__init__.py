"""PyTorch + CUDA port of :mod:`repro`: serving and training.

The package mirrors the JAX package's module names (``configs``,
``core``, ``kernels``, ``models``, ``serving``, ``data``, ``train``,
``checkpoint``, ``launch``) so each module's counterpart is easy to
find, and imports only ``torch``, ``numpy`` and the standard library:
what it needs from
the JAX package's JAX-free modules is copied here, trimmed to what the
port uses.

The main path is the request ``launch/serve.py`` serves: a Bebop RPC
``Infer`` carries a prompt page, which is decoded on the device by a
hand-written CUDA kernel (:mod:`.kernels.bebop_decode`); the
:class:`~repro_torch.serving.engine.PagedBatcher` schedules it (greedy
or seeded sampling), and the paged decoder LM runs its attention through
hand-written CUDA paged attention kernels
(:mod:`.kernels.paged_attention`).  The dense paths (qwen2-1.5b,
recurrentgemma-9b, rwkv6-7b) run the flash attention, RG-LRU and WKV
kernels.

The training path is the JAX package's too (``data``, ``train``,
``checkpoint``): Bebop training pages decoded on the card by the same
decode kernel, a ``Trainer`` that runs AdamW over the models' ``loss``
(differentiating the plain attention and scan versions: no kernel has a
backward, and the wrappers refuse to launch under grad on an input that
requires grad), and Bebop checkpoints in the JAX package's format.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no card and no explicit CPU device they raise.
Each kernel wrapper launches its kernel for CUDA tensors and uses its
plain PyTorch version only for CPU tensors.
"""
