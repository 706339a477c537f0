"""Host-side data: HDF5 datasets, padded batching, device prefetch."""
