"""The training step of the port: optimizer, schedules and train state."""
