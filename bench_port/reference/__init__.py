"""The benchmark's plain reference of the renderer and the depth peel.

Plain PyTorch, frozen copies of the renderer's plain versions (geometry,
anti-aliasing, binning, record table, compositors, peel). It imports
neither JAX, nor the JAX package, nor the PyTorch port: it works out every
table again from the scene's own tensors.
"""
