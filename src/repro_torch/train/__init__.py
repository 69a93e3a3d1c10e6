"""Training: the loss and the train step (``train.loss``, ``train.step``)."""
