"""Launchers of the port: the multi-process runtime (launch/runtime), the
distributed entry point and its dry run (copml_dist, dryrun), training
(train), and what a step costs (roofline, launch_counter)."""
