"""The catalog's science stage on the host (numpy, scipy; h5py and
matplotlib imported where a file is read or a figure drawn): the port's
copies of ``gpy_dla_detection_tpu/analysis/{catalog_tools,comparison,
cddf,external,tables,paper_plots}`` and its port of ``paper_plots_multi``."""
