from qrbench.run import main

raise SystemExit(main())
