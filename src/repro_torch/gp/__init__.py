"""GP maths of the port: hyperparameters, dense kernels, RFF prior samples."""
