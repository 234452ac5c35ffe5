"""Ops of the port: dense and flash attention, paged attention, and the
quantized gradient ring."""
