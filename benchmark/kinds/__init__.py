"""The code that runs each kind of traffic mix (``traffic/<mix>.json``
names its ``kind``): ``kinds/<kind>.py`` with ``run(ctx)`` for one run and
``control(ctx)`` for the control's compared numbers (the reference one
precision step lower in the program's place)."""
