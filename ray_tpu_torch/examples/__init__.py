"""Runnable examples doubling as integration references (reference:
`train/examples/`, `release/air_tests/air_benchmarks/`): the LLM
service (whose model constructors `chip_smoke.py` shares), PPO on
pixels and the MNIST-shaped data-parallel trainer."""
