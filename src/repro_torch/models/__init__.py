"""The LM scaffold's model zoo, serving half: parameter specs, layers,
attention, the Mamba2 SSD block, routed MoE and the unified ``Model``."""
