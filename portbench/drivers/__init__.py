"""One driver per kind of traffic (a traffic file's `kind`): `Run` builds the
program's side from the configuration, the inputs and the weights, does one
unit of the window's work per `unit()`, and `check()` holds what the timed
path produced against the plain reference."""
