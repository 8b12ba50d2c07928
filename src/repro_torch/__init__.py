"""PyTorch/CUDA port of the Anderson-accelerated K-Means solver.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``core.kmeans``, ``core.backends``, ``kernels.fused_lloyd``,
...) and imports nothing of it.  Entry points run on CUDA unless the
caller passes ``device="cpu"``; on a CUDA tensor every kernel is a
hand-written CUDA kernel (``kernels/csrc``), on a CPU tensor its plain
PyTorch version.

    from repro_torch.core import AAKMeans
    model = AAKMeans(n_clusters=1000, backend="fused").fit(x)
    labels = model.predict(x)
"""
