"""The JAX package's Orbax checkpoint format, read and written without orbax or tensorstore.

An Orbax ``StandardSave`` step directory holds JSON metadata and one OCDBT
key-value database (:mod:`.ocdbt`) whose values are zarr v2 arrays
(:mod:`.zarr`), one per leaf, their chunks zstd frames (:mod:`.zstd`, the
decoder is C++ built at first use). :mod:`.tree` maps the step to a nested
tree of arrays and back.
"""
