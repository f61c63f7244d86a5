"""Training layer of the port: optimizer, schedules and the train step."""
