"""Models of the port: the decoder-only transformer LM and the ResNet
job-config generator."""
