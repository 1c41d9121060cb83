from grove_tpu_torch.client.typed import FakeGroveClient, GroveApiError, GroveClient  # noqa: F401
