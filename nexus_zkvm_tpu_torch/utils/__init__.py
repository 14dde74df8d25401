"""Device handling and host timing."""
