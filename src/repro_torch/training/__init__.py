"""The LM scaffold's training substrate: hand-written AdamW, schedules and
global-norm clipping (``optim.py``), the train-step factory
(``train_step.py``) and the state's tree helpers (``tree.py``)."""
