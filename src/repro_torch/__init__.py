"""PyTorch/CUDA port of the ``repro`` package (same module layout).

Host-side replay, cache, trace and prediction code is NumPy and Python, as in
``repro``; the device work of the delivery path (the ARIMA bank kernel and
the k-means Lloyd iterations) runs on the device passed as ``device``, CUDA
by default.  This package imports neither JAX nor ``repro``.
"""
