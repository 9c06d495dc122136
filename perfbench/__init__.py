"""The benchmark of vali_tpu_torch: see README.md."""
