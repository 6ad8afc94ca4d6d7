"""The paper's outer loop in the port: probes, gradients, Adam, fit, predict."""
