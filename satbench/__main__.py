from satbench.run import main

raise SystemExit(main())
