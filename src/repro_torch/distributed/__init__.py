"""The port's distribution: placement rules (``sharding``: the reference's
partition entries as data, blocks placed per rank), the sharded program's
collectives (``collectives``), its rank launcher (``launch``) and the rank
programs that hold it against one rank (``parity``). The layers import
``collectives`` and ``sharding`` imports the models, so this package
imports none of its modules itself."""
