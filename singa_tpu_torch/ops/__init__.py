"""Ops of the port: dense and flash attention, paged attention, the
quantized gradient ring, and the image nets' convolution, pooling, LRN,
dropout, softmax loss, activations and distortion."""
