"""pilosa_tpu_torch: the PyTorch/CUDA port of the bitmap index.

A second package beside ``pilosa_tpu`` (the JAX reference, which it never
imports). Module names mirror the reference so each module's counterpart is
easy to find; inside, planes are int32 tensors that are bit-identical views
of the reference's uint32 words, and the hot loops run through the
hand-written Hopper kernels in ``csrc/bitmap_kernels.cu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a card raises.
"""

__version__ = "0.1.0"
