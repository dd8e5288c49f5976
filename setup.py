from setuptools import find_packages, setup

setup(
    name="pixie_tpu",
    version="0.1.0",
    description="TPU-native (JAX/XLA/Pallas) rebuild of the PIXIE physics-from-pixels pipeline",
    packages=find_packages(exclude=("tests",)),
    package_data={
        "pixie_tpu": ["conf/**/*.yaml", "conf/*.yaml"],
        # the PyTorch port's CUDA sources (built with nvcc at first use) and YAML tree
        "pixie_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "conf/*.yaml", "conf/**/*.yaml"],
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
