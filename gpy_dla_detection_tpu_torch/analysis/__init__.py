"""Catalog post-processing and comparison on the host (numpy, h5py): the
port's copies of ``gpy_dla_detection_tpu/analysis/{catalog_tools,comparison}``."""
