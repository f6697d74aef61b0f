from setuptools import setup, find_packages

setup(
    name='ptina_tpu',
    version='0.1.0',
    description='Differentiable Monte-Carlo path tracer (JAX/XLA/Pallas)',
    packages=find_packages(include=['ptina_tpu', 'ptina_tpu.*']),
    python_requires='>=3.10',
)
