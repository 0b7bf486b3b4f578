"""Pipeline pieces of the port that the serving plane needs (the
admission queue). The actor/learner planes wait for ROADMAP.md Queue 1,
item 10."""
