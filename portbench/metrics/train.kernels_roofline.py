from portbench.readers import kernels_roofline as read  # noqa: F401
