"""Runtime helpers of the serve launcher."""
