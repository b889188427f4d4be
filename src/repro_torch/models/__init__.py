"""The LM scaffold's model zoo: parameter specs, layers, attention, the
Mamba2 SSD block, routed MoE and the unified ``Model`` (serve and train)."""
