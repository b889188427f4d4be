"""Runtime helpers of the launchers: preemption, straggler detection,
heartbeats and gradient compression."""
