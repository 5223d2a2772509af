from setuptools import find_packages, setup

setup(
    name="asvgp_tpu",
    version="0.1.0",
    description=(
        "TPU-native Actually Sparse Variational Gaussian Processes "
        "(JAX/Pallas rebuild of HJakeCunningham/ASVGP)"
    ),
    packages=find_packages(
        include=["asvgp_tpu", "asvgp_tpu.*", "asvgp_tpu_torch", "asvgp_tpu_torch.*"]
    ),
    package_data={"asvgp_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "optax", "numpy"],
)
