"""Host-side featurization (the port has the clustering so far)."""
