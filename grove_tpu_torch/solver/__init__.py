"""The placement engine: encode, solve (kernel or plain version), drain."""
