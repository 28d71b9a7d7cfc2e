"""The container codec path of lzs_tpu_torch (see the package docstring)."""
