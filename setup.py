from setuptools import find_packages, setup

setup(
    name="pixie_tpu",
    version="0.1.0",
    description="TPU-native (JAX/XLA/Pallas) rebuild of the PIXIE physics-from-pixels pipeline",
    packages=find_packages(exclude=("tests",)),
    package_data={
        "pixie_tpu": ["conf/**/*.yaml", "conf/*.yaml"],
        # CUDA sources of the PyTorch port, built with nvcc at first use
        "pixie_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "pyyaml",
    ],
)
