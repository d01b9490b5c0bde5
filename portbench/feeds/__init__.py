"""One module a feed, named by a traffic file's ``feed``: ``make_store``
draws the inputs from the seed, ``program_batches`` serves them to the
program's step as the training CLIs do, and ``reference_samples`` gives the
reference the samples of the first batches that feed serves."""
