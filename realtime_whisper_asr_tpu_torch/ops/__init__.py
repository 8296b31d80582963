"""Device ops of the port: the Whisper log-mel frontend and its mel tables."""
