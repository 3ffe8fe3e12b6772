"""Training of the port: the optimizers (`train.optim`), the train step
(`train.train_step`) and the laned data-parallel step
(`train.laned_sync`)."""
