"""Lab entry points of the port: design experiments beside the product
kernels, run on the card (``python -m vali_tpu_torch.lab.kernel_variants``).
"""
